"""Serving: the state protocol, the lifelong ``UserMemoryStore`` (hpmn,
gru4rec, rum), DIEN's ``HistoryStore``, and ``load_bundle``, which opens
any deployment bundle with its store's class."""

from .history import HistoryStore, load_bundle
from .lifelong import UserMemoryStore
from .protocol import O1_FAMILIES

__all__ = ["UserMemoryStore", "HistoryStore", "load_bundle", "O1_FAMILIES"]
