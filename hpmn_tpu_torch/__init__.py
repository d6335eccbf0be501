"""hpmn_tpu_torch — the PyTorch and CUDA port of ``hpmn_tpu``.

The JAX package stays beside this one as the reference; every module here
mirrors the path of its counterpart there (``hpmn_tpu/models/hpmn.py`` ->
``hpmn_tpu_torch/models/hpmn.py``), and ``tests/test_torch_*.py`` hold each
one to it on the same numpy inputs.

This package imports ``torch`` and numpy only: never ``jax``,
``ml_collections`` or anything under ``hpmn_tpu``, so it runs on a machine
that has none of them. The Pallas kernels of the path it covers are
hand-written CUDA for Hopper (``csrc/``), built from source at first use
(``ops/_build.py``).

Covered so far: the ``hpmn``, ``dien``, ``gru4rec`` and ``rum`` forward
and loss, with the user-embedding tower input (``models.model.apply_model``,
``loss_fn``), the training step and the
training driver with the JAX optimizer's options, eval and checkpoints
(``train.train``: ``train()`` and ``python -m hpmn_tpu_torch.train.train``),
the serving stores (``serving.lifelong.UserMemoryStore``, with its bf16
arena, and ``serving.history.HistoryStore``) with their save/load and
deployment bundles in the JAX package's format, and the train-to-serve
CLIs (``python -m hpmn_tpu_torch.tools.export_bundle`` and
``tools.serve_batch``). Entry points put their tensors on the card unless
the caller passes ``device="cpu"``. What waits is listed in ROADMAP.md.
"""

__version__ = "0.3.0"  # keep in sync with pyproject.toml
