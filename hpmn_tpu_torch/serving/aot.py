"""Ahead-of-time serving: the request math as ``torch.export`` graphs —
counterpart of ``hpmn_tpu/serving/aot.py``.

:func:`export_serving` captures the three request functions of the memory
store, the O(1) update, predict and rank (``lifelong.update_memory``,
``predict_scores``, ``rank_scores``), with ``torch.export``: traced once,
with the batch (``Dim("b")``) and rank's candidate count (``Dim("c")``)
symbolic, one graph per platform (``cpu``, ``cuda``: a traced graph holds
its device), written into the bundle as ``exported_<kind>.<platform>.pt2``
(``torch.export.save``). ``serving/history.py::export_history_scoring`` does
the same for the history store's scoring (every family outside
``protocol.O1_FAMILIES``). :func:`load_aot_store`
serves them with no model code: a host that has this package, the bundle's
``params.npz`` and the graphs runs the graphs the trainer exported, and no
``nn.Module`` is built.

The kernels are in the graphs as custom ops (``ops/library.py``):
``hpmn::readout_fwd`` (K5) in predict and rank, ``hpmn::gru_scan_fwd`` (K1
and K1-scale) in DIEN's scoring. A graph on the card launches the kernels,
and never their plain versions, and counts the launches as eager code does.

Params are NOT in the graphs: they are inputs, after the request's arrays,
in the manifest's ``leaf_order`` (the keystrs of ``params.npz``,
``convert.jax_key``), and the traced model was built on the ``meta``
device, so no weight can be baked in. An int8 bundle composes: the loader
dequantizes (``lifelong._bundle_array``) and the graphs take f32.

The manifest is serving_config.json's ``exported``: ``kinds``,
``leaf_order``, ``platforms``, ``"format": "torch.export"`` and
``torch_version``. A graph is loaded only by the torch version that wrote
it; another raises, naming both. A bundle the JAX package exported
(StableHLO ``exported_*.bin``) is refused with its format named; its params
and memories still load eagerly (``serving.load_bundle``).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.export import Dim

from ..configs import Config, config_from_dict
from ..convert import jax_key
from ..models.model import build_model, model_n_users
from ..ops import library  # noqa: F401  (registers the ops the graphs hold)
from ..train.checkpoint import load_user_memory
from .lifelong import (UserMemoryStore, _bundle_array, predict_scores,
                       rank_scores, update_memory)
from .protocol import n_state_slots

FORMAT = "torch.export"
# The example sizes a graph is traced at: the batch and the candidate
# count, each at least 2 (a size of 0 or 1 could be specialised on) and
# different from each other.
_EXAMPLE_B, _EXAMPLE_C = 3, 2


def leaf_order(model: nn.Module) -> List[str]:
    """The keystrs of the model's parameters in its order: the order in
    which a graph takes them (``convert.jax_key``)."""
    return [jax_key(name) for name, _ in model.named_parameters()]


def _platform_device(platform: str) -> torch.device:
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("exporting for cuda traces on the card, and "
                           "torch.cuda.is_available() is false; pass "
                           "platforms=('cpu',) (--platforms cpu)")
    if platform not in ("cpu", "cuda"):
        raise ValueError(f"export platforms are cpu and cuda, not "
                         f"{platform!r}")
    return torch.device(platform)


class _Request(nn.Module):
    """``fn(model, cfg, *requests)`` as a module holding the model."""

    def __init__(self, fn: Callable, cfg: Config, model: nn.Module):
        super().__init__()
        self.model = model
        self._fn, self._cfg = fn, cfg

    def forward(self, *requests):
        return self._fn(self.model, self._cfg, *requests)


class _Graph(nn.Module):
    """A request function with the model's parameters as inputs:
    ``forward(requests, leaves)``, the leaves in ``leaf_order``. The
    request module is held outside the module tree, so the graph has no
    state of its own."""

    def __init__(self, request: _Request, names: List[str]):
        super().__init__()
        object.__setattr__(self, "_request", request)
        self._names = names

    def forward(self, requests, leaves):
        params = dict(zip(self._names, leaves))
        return torch.func.functional_call(self._request, params,
                                          tuple(requests))


def export_function(fn: Callable, cfg: Config, model: nn.Module,
                    requests: Sequence[torch.Tensor], dims: Sequence,
                    platform: str) -> torch.export.ExportedProgram:
    """Trace ``fn(model, cfg, *requests)`` for ``platform`` with
    ``torch.export``, the parameters as inputs: ``requests`` are example
    arrays (made on the platform's device here), ``dims`` their dynamic
    shapes. The model is rebuilt on the meta device from ``cfg`` and its
    tables' shapes, so its weights cannot enter the graph."""
    device = _platform_device(platform)
    emb = model.embedding
    with torch.device("meta"):
        shell = build_model(cfg, emb.item.shape[0], emb.cat.shape[0],
                            model_n_users(model))
    names = ["model." + name for name, _ in shell.named_parameters()]
    leaves = [p.detach().to(device) for _, p in model.named_parameters()]
    graph = _Graph(_Request(fn, cfg, shell), names)
    # One tensor per input: inputs that share a tensor would be traced as
    # one input.
    requests = tuple(r.to(device, copy=True) for r in requests)
    with torch.no_grad():
        return torch.export.export(
            graph, (requests, leaves),
            dynamic_shapes=(tuple(dims), [None] * len(leaves)))


def export_serving(cfg: Config, model: nn.Module,
                   platforms: Sequence[str] = ("cpu", "cuda"),
                   ) -> Dict[str, Dict[str, torch.export.ExportedProgram]]:
    """Export the memory store's update, predict and rank -> {kind:
    {platform: ExportedProgram}}. Each takes ``(requests, leaves)``:
    update (mem [b, K, d_m] f32, counters [b] int64, items [b], cats [b]
    int32) -> (mem', counters'); predict (mem, uids [b], items [b], cats
    [b]) -> scores [b]; rank (mem, uids [b], items [b, c], cats [b, c]) ->
    scores [b, c]. One graph serves any b and c."""
    for p in platforms:
        _platform_device(p)  # raise before any tracing
    b, c = Dim("b"), Dim("c")
    B, C = _EXAMPLE_B, _EXAMPLE_C
    K, d_m = n_state_slots(cfg), cfg.model.mem_dim
    i32 = torch.int32
    mem = torch.zeros(B, K, d_m)
    vec = torch.zeros(B, dtype=i32)
    mat = torch.zeros(B, C, dtype=i32)
    cnt = torch.zeros(B, dtype=torch.int64)
    specs = {
        "update": (update_memory, (mem, cnt, vec, vec),
                   ({0: b}, {0: b}, {0: b}, {0: b})),
        "predict": (predict_scores, (mem, vec, vec, vec),
                    ({0: b}, {0: b}, {0: b}, {0: b})),
        "rank": (rank_scores, (mem, vec, mat, mat),
                 ({0: b}, {0: b}, {0: b, 1: c}, {0: b, 1: c})),
    }
    return {kind: {p: export_function(fn, cfg, model, reqs, dims, p)
                   for p in platforms}
            for kind, (fn, reqs, dims) in specs.items()}


def _path(directory: str, kind: str, platform: str) -> str:
    return os.path.join(directory, f"exported_{kind}.{platform}.pt2")


def save_exported(directory: str, programs: Dict, model: nn.Module) -> Dict:
    """Write ``{kind: {platform: ExportedProgram}}`` into the bundle ->
    the manifest for serving_config.json's ``exported``."""
    platforms = sorted({p for per in programs.values() for p in per})
    for kind, per in programs.items():
        for platform, ep in per.items():
            torch.export.save(ep, _path(directory, kind, platform))
    return {"kinds": sorted(programs), "leaf_order": leaf_order(model),
            "platforms": platforms, "format": FORMAT,
            "torch_version": torch.__version__}


def leaf_tensors(leaves: Dict[str, np.ndarray], device):
    """A bundle's parameters by keystr, in ``leaf_order`` -> (the f32
    tensors on ``device`` a graph takes, the rows of the user table, or
    without one of SVD++'s ``p_u``)."""
    user = leaves.get("['embedding']['user']",
                      leaves.get("['encoder']['p_u']"))
    return ([torch.as_tensor(np.asarray(a, np.float32), device=device)
             for a in leaves.values()], 0 if user is None else len(user))


class AotStore(UserMemoryStore):
    """A :class:`UserMemoryStore` whose request math runs exported graphs
    (:func:`export_serving`) instead of model code: it gathers the rows
    from the device arena, runs the graph and scatters, as the eager store
    does. ``programs``: {kind: ExportedProgram} for this store's device;
    ``leaves``: the parameters in the manifest's ``leaf_order``."""

    def __init__(self, cfg: Config, leaves: Dict[str, np.ndarray],
                 programs: Dict, max_users: Optional[int] = None,
                 device="cuda", arena_dtype: str = "float32"):
        super().__init__(cfg, None, max_users=max_users, device=device,
                         arena_dtype=arena_dtype)
        self._leaves, self._user_rows = leaf_tensors(leaves, self.device)
        self._run = {kind: ep.module() for kind, ep in programs.items()}

    def _ids(self, a) -> torch.Tensor:
        """Request ids as the graphs take them: int32."""
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def _run_update(self, mem, cnt, items, cats):
        return self._run["update"]((mem, cnt, items, cats), self._leaves)

    def _run_predict(self, mem, uids, items, cats) -> torch.Tensor:
        return self._run["predict"]((mem, uids, items, cats), self._leaves)

    def _run_rank(self, mem, uids, items, cats) -> torch.Tensor:
        return self._run["rank"]((mem, uids, items, cats), self._leaves)

    # ---- trainer-side paths need the model --------------------------------
    def ingest_histories(self, *a, **k):
        raise ValueError("AotStore is a serving-only view (no model code); "
                         "bootstrap histories at export time "
                         "(export_bundle --histories) or with a "
                         "UserMemoryStore")

    def save_bundle(self, *a, **k):
        raise ValueError("AotStore cannot re-export a bundle; its memory "
                         "snapshot persists via save() (the daemon's "
                         "--save_on_exit path)")


def _check_manifest(directory: str, exp: Optional[Dict],
                    platform: str) -> None:
    if not exp:
        raise ValueError(
            f"bundle {directory} has no exported functions; re-export with "
            "save_bundle(export_compiled=True) / export_bundle "
            "--export_compiled")
    fmt = exp.get("format")
    if fmt != FORMAT:
        made = (f"jax {exp['jax_version']}" if "jax_version" in exp
                else "an unknown exporter")
        raise ValueError(
            f"bundle {directory} holds {fmt or 'StableHLO (jax.export)'} "
            f"graphs (exported_*.bin, from {made}), which this package "
            f"cannot run; serve its params and memories eagerly "
            f"(serving.load_bundle) or re-export it with "
            f"python -m hpmn_tpu_torch.tools.export_bundle --export_compiled")
    if exp["torch_version"] != torch.__version__:
        raise ValueError(
            f"bundle {directory} was exported by torch "
            f"{exp['torch_version']}; this is torch {torch.__version__}, "
            f"which does not load its graphs: re-export it here")
    if platform not in exp["platforms"]:
        raise ValueError(
            f"bundle {directory} has graphs for {exp['platforms']}, not "
            f"{platform}: re-export with --platforms {platform}")


def load_aot_store(directory: str, max_users: Optional[int] = None,
                   device="cuda", arena_dtype: str = "float32",
                   max_score_rows: int = 8192):
    """Restore a bundle saved with ``save_bundle(export_compiled=True)``
    on ``device`` into an :class:`AotStore` (memory bundles) or an
    ``AotHistoryStore`` (history bundles, by the bundle's store kind), with
    the graphs of the device's platform and no model code."""
    device = torch.empty(0, device=device).device
    with open(os.path.join(directory, "serving_config.json")) as f:
        meta = json.load(f)
    exp = meta.get("exported")
    _check_manifest(directory, exp, device.type)
    cfg = config_from_dict(meta["config"])
    with np.load(os.path.join(directory, "params.npz")) as z:
        leaves = {key: _bundle_array(z, key) for key in exp["leaf_order"]}
    programs = {kind: torch.export.load(_path(directory, kind, device.type))
                for kind in exp["kinds"]}
    mu = max_users if max_users is not None else meta.get("max_users")
    if meta.get("store", "memory") == "history":
        from .history import AotHistoryStore

        store = AotHistoryStore(cfg, leaves, programs["score"],
                                window=meta.get("window"), max_users=mu,
                                max_score_rows=max_score_rows, device=device)
        store._restore(directory)
        return store
    store = AotStore(cfg, leaves, programs, max_users=mu, device=device,
                     arena_dtype=arena_dtype)
    uids, mem, cnt = load_user_memory(directory)
    if len(uids):
        store._set_rows(uids, mem, cnt)
    return store

