"""Serving: the state protocol, the lifelong ``UserMemoryStore`` (hpmn,
gru4rec, rum), DIEN's ``HistoryStore``, ``load_bundle``, which opens any
deployment bundle with its store's class, and, imported when first named
(as ``hpmn_tpu/serving/__init__.py`` does), the daemon's
``ServingServer``, its ``ServingClient`` and ``ShardedServingClient``, and
the AOT path's ``AotStore``, ``load_aot_store`` and ``export_serving``."""

from .history import HistoryStore, load_bundle
from .lifelong import UserMemoryStore
from .protocol import O1_FAMILIES

__all__ = ["UserMemoryStore", "HistoryStore", "load_bundle", "O1_FAMILIES",
           "ServingServer", "ServingClient", "ShardedServingClient",
           "AotStore", "load_aot_store", "export_serving"]


def __getattr__(name):
    # Lazy: the daemon and the clients pull in sockets and threads, and
    # aot pulls in torch.export, which most imports never need.
    if name == "ServingServer":
        from .server import ServingServer
        return ServingServer
    if name == "ServingClient":
        from .client import ServingClient
        return ServingClient
    if name == "ShardedServingClient":
        from .sharded import ShardedServingClient
        return ShardedServingClient
    if name in ("AotStore", "load_aot_store", "export_serving"):
        from . import aot
        return getattr(aot, name)
    raise AttributeError(name)
