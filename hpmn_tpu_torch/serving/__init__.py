"""Serving: the hpmn state protocol and the lifelong ``UserMemoryStore``."""
