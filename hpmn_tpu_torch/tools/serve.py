"""Online serving daemon CLI: load a bundle, listen, serve — counterpart
of ``tools/serve.py``, with its flags.

    python -m hpmn_tpu_torch.tools.serve --bundle DIR [--host 127.0.0.1]
        [--port 7600] [--device cuda|cuda:N|cpu] [--force_cpu] [--aot]
        [--warmup] [--journal FILE] [--save_on_exit] [--max_batch 256]
        [--max_wait_ms 2.0] [--arena_dtype float32|bfloat16]
        [--extra_bundle NAME=PATH ...]

A launcher for ``hpmn_tpu_torch.serving.server:main`` (see there for
every flag). It serves on the card unless ``--device cpu`` (or
``--force_cpu``) is given, and raises when there is no card. ``--aot``
serves a bundle written with ``export_bundle --export_compiled``. Clients
connect with ``hpmn_tpu_torch.serving.client.ServingClient`` (or the JAX
package's) or speak the length-prefixed JSON frame protocol directly.
"""

from hpmn_tpu_torch.serving.server import main

if __name__ == "__main__":
    main()
